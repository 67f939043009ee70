"""horovod_tpu_torch.compat — see the modules of this package."""
