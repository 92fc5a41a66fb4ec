"""The port's solver core: problem container, factorizations, sketch
ladders (and their one-device shard emulation), the padded adaptive engine
and its path mode, the retry/fallback/deadline/preemption driver, GLM
objectives and the sketched-Newton driver."""

from .robust import PreemptedError

__all__ = ["PreemptedError"]
