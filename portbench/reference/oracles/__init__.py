"""One oracle per analysis call, found by the call's name:
`oracles/<call>.py` (for example `add_com.py`) holds

- `KIND`: how its output is compared (`judge.ERRORS`);
- `oracle(fr, args, kwargs, tol)`: the plain reference of the call's
  output over the block of frames `fr` (`frames.Frames`), with the call's
  arguments as the traffic file gives them; `tol` is the edge reach
  (0 for the control, which must give a single answer);
- optionally `OUTPUT`, the output's name where the call takes no `name`;
  `error(got, want, fr, call)`, a comparison of its own; and
  `control(fr, args, kwargs, want)`, the control's output in the
  program's form where that is not the oracle's first value.

A later change adds a call as one new file here.
"""
