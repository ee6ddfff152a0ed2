"""`{"hbond_chains": [{"acceptors": q, "donors": q, "hydrogens": q}, ...]}`:
the hydrogen-bond chains of `add_hbonds`, each three selection queries,
as the program's `HBondChain`s.  The oracle reads the same queries and
resolves them on the generator's tables itself (`oracles/add_hbonds.py`)."""


def program(value, ctx):
    from groan_rs_tpu_torch.system.hbonds import HBondChain

    return [HBondChain(c["acceptors"], c["donors"], c["hydrogens"]) for c in value]
