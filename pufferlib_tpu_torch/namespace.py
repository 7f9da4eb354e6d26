"""Dict-protocol namespace used as the universal config/record type.

Parity: reference pufferlib/namespace.py:23-55 (namespace() + @dataclass
decorator exposing keys()/values()/items()/__getitem__ on SimpleNamespace).
"""
from types import SimpleNamespace


class Namespace(SimpleNamespace):
    """SimpleNamespace with the dict protocol."""

    def __getitem__(self, key):
        return self.__dict__[key]

    def __setitem__(self, key, value):
        self.__dict__[key] = value

    def __contains__(self, key):
        return key in self.__dict__

    def __iter__(self):
        return iter(self.__dict__)

    def __len__(self):
        return len(self.__dict__)

    def keys(self):
        return self.__dict__.keys()

    def values(self):
        return self.__dict__.values()

    def items(self):
        return self.__dict__.items()

    def get(self, key, default=None):
        return self.__dict__.get(key, default)


def namespace(_self=None, **kwargs):
    """Create a Namespace; also usable to populate an existing object."""
    if _self is None:
        return Namespace(**kwargs)
    _self.__dict__.update(kwargs)
    return _self


def dataclass(cls):
    """Decorator turning a class with annotated defaults into a Namespace
    factory that accepts overrides, mirroring the reference's lightweight
    config records."""
    annotations = getattr(cls, '__annotations__', {})
    defaults = {}
    for name in annotations:
        defaults[name] = getattr(cls, name, None)
    for name, value in vars(cls).items():
        if name.startswith('__') or callable(value):
            continue
        defaults.setdefault(name, value)

    def make(**kwargs):
        unknown = set(kwargs) - set(defaults)
        if unknown:
            raise TypeError(f'{cls.__name__}: unexpected fields {unknown}')
        fields = dict(defaults)
        fields.update(kwargs)
        return Namespace(**fields)

    make.__name__ = cls.__name__
    make.defaults = defaults
    return make
