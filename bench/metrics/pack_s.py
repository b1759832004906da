"""The pack's seconds in set-up: the program's ``pack`` span
(``PartitionRuntime.create``)."""
import program_obs


def read(r):
    return program_obs.once_s(r, "pack")
