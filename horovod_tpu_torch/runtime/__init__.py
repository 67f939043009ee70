"""horovod_tpu_torch.runtime — see the modules of this package."""
