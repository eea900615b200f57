"""Device idle a call, in ms, while the host was under the program's span
``hrt.transmit`` at any depth (:mod:`rtbench.program_spans`): the blocker
fetches and penetration gains under ``transmission``.  Nothing where the
program records no such span (a checkout older than it)."""
from rtbench import program_spans

SPAN = "hrt.transmit"


def read(ctx):
    session = program_spans.latest_session()
    if session is None or not any(sp.name == SPAN
                                  for sp in session.finished()):
        return None
    return program_spans.idle_ms(ctx, SPAN)
