"""The examples' shared command line: the device their pilots run on and
the number of ranks of the pilot world."""
from __future__ import annotations

import argparse

import torch


def parser(doc: str, ranks: bool = True) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (every rank on the card) or cpu")
    if ranks:
        ap.add_argument("--ranks", type=int, default=4,
                        help="rank processes in the pilot's world")
    return ap


def devices(args) -> list:
    """The pilot's devices; ``cuda`` raises without a card, as the port's
    entry points do."""
    from repro_torch.device import resolve_device
    return [torch.device(resolve_device(args.device))]
