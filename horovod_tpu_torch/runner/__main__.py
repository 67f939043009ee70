import sys

from horovod_tpu_torch.runner import main

if __name__ == "__main__":
    sys.exit(main())
