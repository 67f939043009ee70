"""horovod_tpu_torch.analysis — see the modules of this package."""
