"""``python -m cruise_control_tpu_torch`` (counterpart of
``cruise_control_tpu/__main__.py``): the service's entry point."""
from cruise_control_tpu_torch.main import main

if __name__ == "__main__":
    raise SystemExit(main())
