"""Share of its roofline of the RDF's pair histogram: the public
`ops.distances.pair_distance_histogram` at one batch of the cell's
Peptide x Membrane frames (32 x 400 x 300,000 pairs, r_max 2.0, 200
bins), timed with CUDA events, against `roofline.rdf_work`."""

NAME, UNIT, BETTER, SOURCE = "rdf_roofline_pct", "%", "higher", "device_trace"
LAYER = "plain-torch observables: ops/distances.py pair_distance_histogram"
MOVES = "streamed_frames_per_s"


def read(ctx):
    if not ctx.cuda or not any(c["call"] == "add_rdf" for c in ctx.traffic["analysis"]):
        return None
    from groan_rs_tpu_torch.ops import distances

    from portbench import roofline

    pos, box = ctx.sample_batch(ctx.batch)
    a = pos[:, ctx.group("Peptide")].contiguous()
    b = pos[:, ctx.group("Membrane")].contiguous()
    del pos
    s = ctx.time_op(lambda: distances.pair_distance_histogram(a, b, box, 2.0, 200), reps=2)
    return roofline.share_pct(roofline.rdf_work(a.shape[0], a.shape[1], b.shape[1], 200), s)
