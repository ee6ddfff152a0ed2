"""`{"system": true}`: the program's System itself (the RMSD's reference
structure)."""


def program(value, ctx):
    return ctx.system
