#!/usr/bin/env python3
"""The training and mesh phases of one checkout, alone in a process.

Runs phases of the checkout at ``TREE`` (its own ``chip_smoke.py`` and
``src/``): ``train_phase`` for llama3.2-1b and then gpt-1.5B, or the
cells named in a third argument, a comma-separated list of
llama3.2-1b, gpt_paper, jamba-v0.1-52b (``cut_train_phase``),
multirank (``multirank_phase``: llama3.2-1b trained on four gloo ranks)
and serve_multirank (``serve_multirank_phase``: served on four gloo
ranks in each of the checkout's layouts), with nothing else in the
process, and prints one line ``AB <tag> {cell: [step ms, ...]}``; a
serve cell gives ``{layout: [decode step ms, ...]}``. Alternating two
checkouts in one session on one card (``A B A B ...``) compares their
steps without the other phases of ``chip_smoke.py`` before them::

    python3 tools/train_ab.py build/final_tree F1
    python3 tools/train_ab.py build/parent_tree P1 jamba-v0.1-52b
    python3 tools/train_ab.py build/parent_tree P1 multirank,serve_multirank

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
    cells = {c["arch"]: (c, cs.train_phase) for c in (cs.LLAMA, cs.GPT)}
    cells[cs.JAMBA_TRAIN["arch"]] = (cs.JAMBA_TRAIN, cs.cut_train_phase)
    cells["multirank"] = (cs.MULTI, cs.multirank_phase)
    cells["serve_multirank"] = (cs.SERVE_MULTI, cs.serve_multirank_phase)
    names = (sys.argv[3].split(",") if len(sys.argv) > 3
             else [cs.LLAMA["arch"], cs.GPT["arch"]])
    out = {}
    for name in names:
        cell, phase = cells[name]
        res = phase(torch, cell)
        out[name] = ({lay: [round(t, 1) for t in row["decode_step_ms"]]
                      for lay, row in res["layouts"].items()}
                     if "layouts" in res else
                     [round(s["ms"], 1) for s in res["steps"]])
    print("AB", tag, json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
