"""idle_while_held_pct.paced: idle_while_held_pct.free's quantity in the paced cell."""

from ltbench.spans import idle_shares


def read(run):
    shares = idle_shares(run)
    return None if shares is None else shares[1]
