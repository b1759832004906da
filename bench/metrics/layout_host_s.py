"""The layout's host half in set-up: the program's ``layout.host`` span
(``LocalBSR.build``'s degrees, order, ELL slots, ``cols``/``gather``/
``rank``)."""
import program_obs


def read(r):
    return program_obs.once_s(r, "layout.host")
