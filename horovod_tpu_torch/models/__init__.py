"""horovod_tpu_torch.models — see the modules of this package."""
