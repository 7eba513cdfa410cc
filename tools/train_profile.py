#!/usr/bin/env python3
"""One training step of a ``chip_smoke.py`` training cell under
torch.profiler, for a cell whose profile does not fit the smoke test's
time limit.

Runs ``chip_smoke.py``'s ``profile_train`` (a ``train_step`` and an
``opt_step`` on fresh params from seed 0 under
``torch.profiler.profile``: device busy share, kernels by device time,
the port's kernels' device time and launches) for each training cell
named, by arch: llama3.2-1b, gpt_paper, jamba-v0.1-52b, xlstm-1.3b. The
xlstm-1.3b cut launches ~317 k kernels a step (its plain mLSTM's chunk
loop), which takes the profiler minutes, so ``chip_smoke.py`` leaves it
out. The trace goes to ``build/chip_smoke/train_trace_<arch>.json``::

    python3 tools/train_profile.py xlstm-1.3b

Needs one NVIDIA GPU; builds the kernels into ``build/``; imports
nothing of jax.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        cs.fail("no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cells = {c["arch"]: c for c in (cs.LLAMA, cs.GPT, cs.JAMBA_TRAIN,
                                    cs.XLSTM_TRAIN)}
    unknown = [a for a in sys.argv[1:] if a not in cells]
    if unknown or not sys.argv[1:]:
        cs.fail(f"name training cells among {sorted(cells)}, not "
                f"{unknown or 'none'}")
    cs.OUT.mkdir(parents=True, exist_ok=True)
    build.build_all()
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip())
    out = [cs.profile_train(torch, cells[a]) for a in sys.argv[1:]]
    (cs.OUT / "train_profile.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
