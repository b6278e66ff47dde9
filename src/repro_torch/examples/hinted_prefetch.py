"""Hinted vs lookahead-prefetch tiering on a phase-shifting DLRM trace
(PyTorch counterpart of ``examples/hinted_prefetch.py``).

The paper's §VI triad is reactive placement, proactive movement, and
*compiler hints*.  This walkthrough runs the online EpochRuntime with the
``repro_torch.hints`` pipeline attached and compares the two hint-fed lanes:

* ``hinted``   — PEBS telemetry blended with *static* hints from the
  embedding-table structure (Zipf prior + the compiler's rank->page layout).
  Exact before the hot set rotates; stale after — the EWMA phase-change
  detector then down-weights it.
* ``prefetch`` — *lookahead* hints: the dataloader's queued next-epoch
  batches, promoted before the accesses land.  Covers the rotation in the
  very epoch it happens, and its migration streams under the access stream
  (overlap-aware accounting, ``MemSystem.overlapped_epoch_time_s``).

The printed lines are the reference example's, line for line.

    python -m repro_torch.examples.hinted_prefetch                # GPU
    python -m repro_torch.examples.hinted_prefetch --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from ..dlrm import datagen
from ..scenarios import run_online

__all__ = ["N_EPOCHS", "SHIFT_AT", "SPEC", "main"]

SPEC = datagen.SMALL
N_EPOCHS, SHIFT_AT = 8, 4


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    kw = dict(spec=SPEC, n_epochs=N_EPOCHS, shift_at=SHIFT_AT, hints=True,
              seed=0, device=args.device)

    # ---- one trajectory, hints on: static + lookahead + phase detector
    out = run_online(**kw)
    lanes = out["trajectory"]["lanes"]

    print(f"phase-shift trace: {SPEC.n_pages} pages, hot set rotates at "
          f"epoch {SHIFT_AT}\n")
    print(f"{'epoch':>5s} {'hinted cov':>11s} {'prefetch cov':>13s} "
          f"{'prefetch hidden':>16s}")
    for e in range(N_EPOCHS):
        h, p = lanes["hinted"][e], lanes["prefetch"][e]
        marker = "  <- shift" if e == SHIFT_AT else ""
        print(f"{e:>5d} {h['coverage']:>11.2f} {p['coverage']:>13.2f} "
              f"{p['hidden_s']*1e6:>14.1f}us{marker}")

    s = out["summary"]
    print(f"\npost-shift mean coverage: hinted "
          f"{s['hinted']['post_shift_mean_coverage']:.2f} vs prefetch "
          f"{s['prefetch']['post_shift_mean_coverage']:.2f} "
          f"(lookahead sees the rotation in the epoch it happens; the static "
          f"table prior goes stale)")

    # ---- overlap-aware migration accounting: same lane, overlap on vs off
    times = {}
    for overlap in (1.0, 0.0):
        r = run_online(prefetch_overlap=overlap, **kw)
        times[overlap] = np.array(
            [rec["time_s"] for rec in r["trajectory"]["lanes"]["prefetch"]])
    assert (times[1.0] <= times[0.0]).all()
    saved = (times[0.0] - times[1.0]).sum()
    print(f"\noverlapped migration saves {saved*1e6:.0f}us over the "
          f"trajectory ({(times[0.0].sum() / times[1.0].sum() - 1) * 100:.1f}"
          f"% of epoch time vs stop-the-world migration) ✓")


if __name__ == "__main__":
    main()
