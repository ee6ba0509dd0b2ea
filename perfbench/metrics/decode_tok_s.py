"""``decode_tok_s``: batch x decode steps completed, over all of the
window's time (host clock around a window that ends in a
synchronisation)."""


def read(run):
    rec = run.record
    if "steps" not in rec or rec["seconds"] <= 0:
        return None
    return rec["steps"] * rec["batch"] / rec["seconds"]
