"""Share of its roofline of the triclinic pair path: the public
`ops.distances.min_distance_triclinic` at one batch of the cell's
Peptide x Membrane frames (12 x 400 x 300,000 pairs, dodecahedron
boxes), timed with CUDA events, against `roofline.pair_min_work` with
`TRICLINIC_PAIR_MIN_OPS` a pair."""

NAME, UNIT, BETTER, SOURCE = "tric_pair_roofline_pct", "%", "higher", "device_trace"
LAYER = "triclinic pair path: ops/distances.py min_distance_triclinic, ops/pbc.py"
MOVES = "streamed_frames_per_s"


def read(ctx):
    if not ctx.cuda or not ctx.syn.triclinic:
        return None
    from groan_rs_tpu_torch.ops import distances

    from portbench import roofline

    pos, box = ctx.sample_batch(ctx.batch)
    a = pos[:, ctx.group("Peptide")].contiguous()
    b = pos[:, ctx.group("Membrane")].contiguous()
    del pos
    s = ctx.time_op(lambda: distances.min_distance_triclinic(a, b, box), reps=2)
    work = roofline.pair_min_work(a.shape[0], a.shape[1], b.shape[1], box_floats=9,
                                  ops_per_pair=roofline.TRICLINIC_PAIR_MIN_OPS)
    return roofline.share_pct(work, s)
