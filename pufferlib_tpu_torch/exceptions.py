"""API misuse errors. Parity: reference pufferlib/exceptions.py."""


class APIUsageError(RuntimeError):
    """Raised when the framework API is used incorrectly (step before
    reset, recv before send, bad divisibility, space mismatch...)."""

    def __init__(self, message='API usage error'):
        super().__init__(message)


class InvalidAgentError(ValueError):
    """Raised when an unknown agent key is supplied to a multi-agent env."""

    def __init__(self, agent_id, agents):
        super().__init__(
            f'Invalid agent {agent_id}. Valid agents: {list(agents)}')


class EpisodeLimitExceeded(RuntimeError):
    """Raised by env wrappers whose episode budget is exhausted (e.g.
    bsuite mandates exactly bsuite_num_episodes episodes). In HostSerial
    it propagates to the caller; in HostMultiprocessing the worker exits
    and the envpool's worker-death watchdog surfaces the failure."""

    def __init__(self, message='episode limit exceeded'):
        super().__init__(message)
