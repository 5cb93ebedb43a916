"""Host milliseconds a search round spends in its one sync, over the traced
window: the program's ``search.round_seconds{phase=sync}`` (the loop
condition's copy to the host, ``core/search.py``) over its
``search.rounds``.  On the card the sync waits for the round's device work,
so this is the share of a round the host waits on the card.  Read where the
window was traced on the card; elsewhere, and where the program keeps no
such sum, nothing."""
UNIT = "ms"
LAYER = "search loop"
KEY = "search.round_seconds[phase=sync].sum"


def read(ctx):
    reg = ctx.registry
    if not reg or ctx.device is None or not reg.get("search.rounds") or KEY not in reg:
        return None
    return 1e3 * reg[KEY] / reg["search.rounds"]
