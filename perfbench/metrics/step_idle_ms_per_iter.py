"""The card's idle milliseconds per iteration inside the `fused.step`
spans: what the stage launches and the flag reads cost, apart from the
idle of the driver's scalar read between iterations."""

from perfbench import spans


def read(w):
    return spans.idle_ms_in(w, spans.STEP)
