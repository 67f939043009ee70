"""horovod_tpu_torch.resilience — see the modules of this package."""
