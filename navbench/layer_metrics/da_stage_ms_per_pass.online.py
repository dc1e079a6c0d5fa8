"""Host time of the online step's data-association stage (the ``jacfwd``
correspondence over the slots and the cost table): the mean of the port's
``slam.da_stage`` spans (one per sensor pass with detections), in ms."""

from navbench import spans


def read(trace, cell):
    return spans.mean_ms(trace, "slam.da_stage")
