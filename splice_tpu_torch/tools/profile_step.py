"""Device trace of the bench's replayed steps (port of
scripts/profile_step.py).

    python -m splice_tpu_torch.tools.profile_step [trace_dir] [mode ...]

The configuration of tools/ablate.py (cows, seed 3, bf16; ablation modes
apply): one warm chunk of 10 steps, then utils.profiling.maybe_trace over
two chunks of 10 replayed regular steps, ending with their one read.
Aggregate the trace with `python -m splice_tpu_torch.tools.trace_agg
<trace_dir> 20`. The default trace_dir is out/trace_step.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, Sequence

from splice_tpu_torch.tools.ablate import CHUNK, ablation, bench_program
from splice_tpu_torch.utils.profiling import maybe_trace

TRACED_CHUNKS = 2


def profile(trace_dir: str, modes: Sequence[str] = (),
            device=None) -> Dict[str, Any]:
    """Warm, then trace TRACED_CHUNKS chunks of CHUNK replayed steps into
    trace_dir. Returns the steps traced and the program."""
    with ablation(modes) as keys:
        cfg, program, rows = bench_program(keys, device)
        program.run(rows(CHUNK, 4), False)
        timed = [rows(CHUNK, 5 + i) for i in range(TRACED_CHUNKS)]
        with maybe_trace(trace_dir, device=program.trainer.device):
            for r in timed:
                program.dispatch(r, False)
            program.fetch(CHUNK)
    return {"steps": TRACED_CHUNKS * CHUNK, "program": program}


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    trace_dir = args.pop(0) if args else "out/trace_step"
    res = profile(trace_dir, args)
    print(f"trace done, steps: {res['steps']} -> {trace_dir}")


if __name__ == "__main__":
    main()
