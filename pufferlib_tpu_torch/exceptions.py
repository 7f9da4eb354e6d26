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
