from repro_torch.sim.clock import Clock, EventLoop, RealClock  # noqa: F401
from repro_torch.sim.hardware import HARDWARE, HardwareSpec    # noqa: F401
