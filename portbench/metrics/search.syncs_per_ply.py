"""search.syncs_per_ply: host syncs the search made a ply, summed over
causes of `mcts.gumbel.COUNTERS.syncs`, as a delta over the whole window."""


def read(rec):
    w = rec.window
    if not w or not w["plies"]:
        return None
    return w["syncs"] / w["plies"]
