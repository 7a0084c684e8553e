"""``python -m yoho_tpu_torch`` == the ``yoho-torch`` umbrella command."""

from yoho_tpu_torch.cli.__main__ import main

if __name__ == "__main__":
    raise SystemExit(main())
