import sys

from dplasma_tpu_torch.drivers import main

if __name__ == "__main__":
    sys.exit(main())
