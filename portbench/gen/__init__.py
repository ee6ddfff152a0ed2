"""Input generation: one module per generator, and the frozen XTC writer.

A configuration names its generator (`"generator": "synthetic"`); the
harness finds `gen/<generator>.py` by that name and calls its
`make(config, seed, device, n_frames=None)`.  What `make` returns is the
system the run and the plain reference read:

- `config`, `n` (atoms), `h` (float32 box matrix, rows the box vectors),
  `box9` (the box as XTC stores it), `triclinic`, `precision`, `dt_ps`;
- `grid_frame0()` and `grid_frames(start, stop)`: the frames as int32
  points of the XTC precision grid on the device, made again from the
  seed on every call; `host_frames(stop)` the same as host numpy;
  `positions(q, dtype)` grid points in nm;
- `masses()`, `charges()`, `state(topology)` (what
  `convert.system_from_state` takes), and the tables that argument kinds
  and oracles read (`layout()`, `cylinder_args()` here).

A later change adds a generator as one new file here.
"""
