"""Host milliseconds of one search round outside its sync, over the traced
window: the program's ``search.round_seconds{phase}`` sums of ``stage_a``,
``fetch``, ``rerank`` and ``expand`` (``core/search.py``; the host time of
each phase, summed over a call's rounds while the process tracer is on) over
its ``search.rounds``.  Read where the window was traced on the card (a
device trace beside it); elsewhere, and where the program keeps no such
sums, nothing."""
UNIT = "ms"
LAYER = "search loop"
PHASES = ("stage_a", "fetch", "rerank", "expand")


def read(ctx):
    reg = ctx.registry
    if not reg or ctx.device is None or not reg.get("search.rounds"):
        return None
    keys = [f"search.round_seconds[phase={p}].sum" for p in PHASES]
    if not all(k in reg for k in keys):
        return None
    return 1e3 * sum(reg[k] for k in keys) / reg["search.rounds"]
