"""horovod_tpu_torch.utils — see the modules of this package."""
