"""`{"cylinder": "z"}`: the generator's cylinder (`cylinder_args()`,
position, radius and height) along the named axis, as the program's
`Cylinder`."""


def program(value, ctx):
    from groan_rs_tpu_torch.core.dimension import Dimension
    from groan_rs_tpu_torch.core.shapes import Cylinder

    return Cylinder(*ctx.syn.cylinder_args(), getattr(Dimension, value.upper()))
