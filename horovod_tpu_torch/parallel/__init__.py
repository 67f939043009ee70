"""horovod_tpu_torch.parallel — see the modules of this package."""
