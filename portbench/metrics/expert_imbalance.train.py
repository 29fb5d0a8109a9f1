"""expert_imbalance.train: the held experts' load imbalance weighted by
rows, over every layer of the traced steps: the sum of each layer's
largest held expert's rows over the sum of its held experts' mean rows
(the program's ``moe.rows`` counter: each layer's routed rows and its
largest expert's). 1 is an even split. A layer counts by the rows it
routes, so a layer whose held experts take few rows cannot pin the
reading at its ceiling (``experts_held``), as a worst-layer maximum
would; the reading moves with the router's balance wherever the held
experts do the work, which is where K13 spends its time."""

from portbench import counters


def read(ctx):
    rows = counters.program_counts("moe.rows")
    if rows is None:
        return None
    held = ctx["cell"]["config"]["port"]["experts_held"]
    total = sum(t for t, _ in rows)
    if total <= 0:
        return None
    return held * sum(big for _, big in rows) / total
