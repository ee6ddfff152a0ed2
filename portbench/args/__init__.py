"""Argument kinds of a traffic file's calls, one file each, found by name.

In a call's `args` or `kwargs`, a one-key object whose key names a file
here (`{"site": "water_angles"}`) stands for a value of the program's
that the traffic file cannot spell: `args/<key>.py` `program(value, ctx)`
gives it, where `ctx` holds the run's generator (`syn`), the state handed
to the program (`state`) and the program's System (`system`).  The
oracles read the same thing from the generator themselves.

A later change adds an argument kind as one new file here.
"""
