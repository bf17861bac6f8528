"""Warning categories for the repro_torch package.

Kept import-light on purpose: ``python -W
error::repro_torch._warnings.SpadeDeprecationWarning`` resolves the
category at interpreter start, so this module must not pull in anything
heavy (torch included).
"""

__all__ = ["SpadeDeprecationWarning"]


class SpadeDeprecationWarning(DeprecationWarning):
    """Raised by the legacy string/flag entrypoints (``run_service``) that
    the ``SuspSemantics`` + ``SpadeService`` API replaces.

    Deprecation policy: the shims stay source-compatible for existing
    callers and tests; first-party code (examples, the CLI) must not
    trigger them.
    """
