"""Traffic classes for admission and preemption.

Counterpart of ``accelerate_tpu/serving/control.py``: the port takes
:class:`PriorityPolicy` (``:58``), which the engine's
:class:`~.scheduler.AdmissionQueue` and its pool-exhaustion preemption
consult. The rate limiters, fair-share admission and the autoscaler come
with the gateway and the fleet.
"""

from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["DEFAULT_PRIORITY_CLASSES", "PriorityPolicy"]

#: Highest-priority first. ``standard`` is the default class for requests
#: that carry no ``priority`` (and for unknown class names, so a typo'd
#: class degrades to normal service instead of starving or dominating).
DEFAULT_PRIORITY_CLASSES = ("interactive", "standard", "batch")


class PriorityPolicy:
    """A total order over named traffic classes.

    ``rank(name)`` maps a class name to its position (0 = most
    important); ``None`` and unknown names map to the default class, so
    priority-less traffic keeps exactly its pre-policy behavior — with
    every request unranked the priority queue degenerates to FIFO and
    victim selection degenerates to newest-admitted.
    """

    def __init__(self, classes: Sequence[str] = DEFAULT_PRIORITY_CLASSES,
                 default: Optional[str] = None):
        classes = tuple(classes)
        if not classes:
            raise ValueError("PriorityPolicy needs at least one class")
        if len(set(classes)) != len(classes):
            raise ValueError(f"duplicate priority class in {classes}")
        if default is None:
            default = ("standard" if "standard" in classes
                       else classes[len(classes) // 2])
        if default not in classes:
            raise ValueError(
                f"default class {default!r} not in classes {classes}")
        self.classes = classes
        self.default = default
        self._rank = {name: i for i, name in enumerate(classes)}
        self._default_rank = self._rank[default]

    def rank(self, priority: Optional[str]) -> int:
        """0 = most important; ``None``/unknown -> the default class."""
        if priority is None:
            return self._default_rank
        return self._rank.get(priority, self._default_rank)

    def __repr__(self):
        return (f"PriorityPolicy({'>'.join(self.classes)}, "
                f"default={self.default!r})")
