"""Filter layer (``parallel/mesh.agent_step``): device milliseconds per fleet
frame of the IMU batch (``process_imu_batch_impl`` and the measurement state's
lookup), from the ``imu`` stamp to the ``rows`` stamp in the filter's graph."""
from .recorded import stage


def read(run):
    return stage(run, "imu")
