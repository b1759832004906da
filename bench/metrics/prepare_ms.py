"""ms a query spends preparing (the backend and the upload of the static
tree): the self time of the program's ``bsp.prepare`` spans over the
run's queries."""
import program_obs


def read(r):
    return program_obs.per_query(
        r, lambda t: 1e3 * t["spans"]["bsp.prepare"]["self_s"])
