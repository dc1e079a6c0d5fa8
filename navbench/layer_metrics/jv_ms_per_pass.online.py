"""Host time of the online step's assignment (the cost table to the host,
the JV loop, the result back to the device): the mean of the port's
``slam.jv`` spans (one per sensor pass with detections), in ms."""

from navbench import spans


def read(trace, cell):
    return spans.mean_ms(trace, "slam.jv")
