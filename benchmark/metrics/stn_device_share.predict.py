"""Share of the card's busy time in what the ResNet STN launches in
predict: the device time under the program's ``model.stn`` span."""
from readers import span_share


def read(r):
    return span_share(r, "model.stn")
