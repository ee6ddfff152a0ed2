"""The frame-batch pass engine and the map-reduce over trajectories."""

from .engine import DeviceTrajectory, FrameEngine, traj_iter_map_reduce

__all__ = ["DeviceTrajectory", "FrameEngine", "traj_iter_map_reduce"]
