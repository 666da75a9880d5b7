"""Share of the predict window in which the card ran nothing."""
from readers import idle_share


def read(r):
    return idle_share(r)
