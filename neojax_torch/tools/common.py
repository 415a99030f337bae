"""What the sweep tools share: their command line (``--out PATH``,
``--smoke``) and their one JSON line on standard output, written to
``--out`` too when given."""

from __future__ import annotations

import argparse
import json
import sys


def parse(doc: str, argv=None, device: bool = False) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--out", help="write the JSON here too (a path the caller chooses)")
    ap.add_argument("--smoke", action="store_true", help="the reduced grid (a quick check of the card)")
    if device:
        ap.add_argument("--device", default="cuda", help="where the convolutions run (default: the card)")
    return ap.parse_args(argv)


def finish(result: dict, out: str | None) -> None:
    """Print ``result`` as one JSON line, and write it to ``out``."""
    text = json.dumps(result)
    print(text, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")


def note(text: str) -> None:
    """A progress line on standard error."""
    print(f"# {text}", file=sys.stderr, flush=True)
