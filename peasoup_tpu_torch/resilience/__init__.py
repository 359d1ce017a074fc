"""The transient-error class (:mod:`.errors`) and the retry policy the
candidate database runs its transactions under (:mod:`.policy`); the rest
of the JAX package's resilience layer is ROADMAP item A.10."""

from .errors import TransientIOError, is_transient
