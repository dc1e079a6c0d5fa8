"""Host time of the online step's commit (``select_updates``, the index
writes, the sequential update K3): the mean of the port's ``slam.commit``
spans (one per sensor pass with detections), in ms."""

from navbench import spans


def read(trace, cell):
    return spans.mean_ms(trace, "slam.commit")
