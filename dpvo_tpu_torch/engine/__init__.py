"""The SLAM engine of the port."""
from .dpvo import DPVO
from .state import DeviceState, HostState, allocate, allocate_host

__all__ = ["DPVO", "DeviceState", "HostState", "allocate", "allocate_host"]
