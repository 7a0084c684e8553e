"""``yoho-torch create-session``: scaffold a training session.

Usage: ``python -m yoho_tpu_torch.cli create-session [name] [--root ./sessions]``
"""

from __future__ import annotations

import argparse

from yoho_tpu_torch.train.session import create_session


def main(argv=None):
    parser = argparse.ArgumentParser(prog="yoho-torch create-session",
                                     description="Create a new YOHO training session")
    parser.add_argument("name", type=str, nargs="?", default="main",
                        help="Name of the session")
    parser.add_argument("--root", type=str, default="./sessions")
    args = parser.parse_args(argv)
    try:
        path = create_session(args.name, args.root)
    except FileExistsError:
        print("Session with this name already exists!")
        return 1
    print(f"Created session at {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
