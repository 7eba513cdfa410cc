#!/usr/bin/env python3
"""The one-rank training phases of one checkout, alone in a process.

Runs ``chip_smoke.train_phase`` of the checkout at ``TREE`` (its own
``chip_smoke.py`` and ``src/``) for llama3.2-1b and then gpt-1.5B, with
nothing else in the process, and prints one line ``AB <tag> {arch: [step
ms, ...]}``. Alternating two checkouts in one session on one card
(``A B A B ...``) compares their training steps without the other phases
of ``chip_smoke.py`` before them::

    python3 tools/train_ab.py build/final_tree F1
    python3 tools/train_ab.py build/parent_tree P1

Needs one NVIDIA GPU; builds the checkout's kernels into its own
``build/``; imports nothing of jax.
"""

from __future__ import annotations

import json
import pathlib
import sys


def main() -> None:
    tree = pathlib.Path(sys.argv[1]).resolve()
    tag = sys.argv[2] if len(sys.argv) > 2 else tree.name
    sys.path.insert(0, str(tree))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        cs.fail("no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.OUT.mkdir(parents=True, exist_ok=True)
    build.build_all()
    out = {}
    for cell in (cs.LLAMA, cs.GPT):
        res = cs.train_phase(torch, cell)
        out[cell["arch"]] = [round(s["ms"], 1) for s in res["steps"]]
    print("AB", tag, json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
