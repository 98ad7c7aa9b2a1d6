"""Kernel launch counters: each kernel wrapper adds one to its entry where it
launches its kernel, and nowhere else."""


class LaunchCounter(dict):
    """Kernel launches per variant since the last ``reset``."""

    def reset(self):
        for k in self:
            self[k] = 0
