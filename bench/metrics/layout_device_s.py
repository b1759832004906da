"""The layout's device half in set-up: the program's ``layout.device``
span (``LocalBSR.build``'s fill and scatter of the blocks and the copies
to the card, ending on a synchronize)."""
import program_obs


def read(r):
    return program_obs.once_s(r, "layout.device")
