"""Share of its roofline of the refined centre: the public
`ops.center.center` of the cell's Protein frames with masses ([32,
99,000]), against `roofline.center_work` (bytes bound: the positions
read once).  One call's device work (K1, K2 and their glue) is shorter
than the host's issue of it, so host-paced calls would time the host:
20 calls are captured in a CUDA graph and the replay is timed with CUDA
events (`Run.time_graph`)."""

NAME, UNIT, BETTER, SOURCE = "center_roofline_pct", "%", "higher", "device_trace"
LAYER = "kernels: ops/center.py center (K1 + K2)"
MOVES = "resident_frames_per_s"


def read(ctx):
    if not ctx.cuda or ctx.syn.triclinic:
        return None
    import torch

    from groan_rs_tpu_torch.ops import center

    from portbench import roofline

    pos, box = ctx.sample_batch(ctx.batch)
    g = ctx.group("Protein")
    p = pos[:, g].contiguous()
    del pos
    w = torch.as_tensor(ctx.syn.masses()[g], device=p.device)
    s = ctx.time_graph(lambda: center.center(p, box, weights=w), reps=20)
    return roofline.share_pct(roofline.center_work(p.shape[0], p.shape[1], True), s)
