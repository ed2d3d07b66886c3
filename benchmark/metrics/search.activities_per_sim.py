"""Device activities (kernels, copies, fills) of the traced chunk per
simulation: the search's and the ply's launches, most of them the host's
dispatch of small torch operations."""


def read(facts, cell):
    sims = facts.counts["plies"] * facts.counts["simulations"]
    if not facts.activities or sims <= 0:
        return None
    return len(facts.activities) / sims
