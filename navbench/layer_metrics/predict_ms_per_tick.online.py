"""Host time of the online step's motion predict: the mean of the port's
``slam.predict`` spans (one per tick), in ms."""

from navbench import spans


def read(trace, cell):
    return spans.mean_ms(trace, "slam.predict")
