"""Share of its roofline of the orthorhombic pair reduction: the public
`ops.distances.min_distance` on one batch of the cell's Peptide and
Membrane frames (32 x 400 x 300,000 pairs), timed with CUDA events,
against `roofline.pair_min_work`."""

NAME, UNIT, BETTER, SOURCE = "k3_roofline_pct", "%", "higher", "device_trace"
LAYER = "kernels: ops/distances.py min_distance (K3)"
MOVES = "resident_frames_per_s"


def read(ctx):
    if not ctx.cuda or ctx.syn.triclinic:
        return None
    from groan_rs_tpu_torch.ops import distances

    from portbench import roofline

    pos, box = ctx.sample_batch(ctx.batch)
    a = pos[:, ctx.group("Peptide")].contiguous()
    b = pos[:, ctx.group("Membrane")].contiguous()
    del pos
    s = ctx.time_op(lambda: distances.min_distance(a, b, box), reps=10)
    return roofline.share_pct(roofline.pair_min_work(a.shape[0], a.shape[1], b.shape[1]), s)
