"""`{"site": <table>}`: the generator's index table of that name, as the
state hands it to the program (`state["sites"]`)."""


def program(value, ctx):
    return ctx.state["sites"][value]
