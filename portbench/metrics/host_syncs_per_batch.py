"""Host synchronisations a resident batch makes: one more pass after the
window under `torch.cuda.set_sync_debug_mode("warn")`, its warnings
counted, over the pass's batches (the fetch of the results counts too)."""

import warnings

NAME, UNIT, BETTER, SOURCE = "host_syncs_per_batch", "count", "lower", "program_counter"
LAYER = "parallel/engine.py resident loop"
MOVES = "resident_frames_per_s"


def read(ctx):
    if ctx.traffic["entry"] != "resident" or not ctx.cuda:
        return None
    torch = ctx.torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ctx.run_pass()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n = sum("synchroniz" in str(w.message) for w in got)
    return n / ctx.batches_per_pass
