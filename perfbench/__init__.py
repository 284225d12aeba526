"""The benchmark of spmv_acc_tpu_torch: ``python3 -m perfbench.run`` (README.md)."""
