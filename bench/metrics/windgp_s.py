"""WindGP's seconds in set-up: the program's ``windgp`` span (its three
phases and the evaluation)."""
import program_obs


def read(r):
    return program_obs.once_s(r, "windgp")
