"""Unique name generator (reference: python/paddle/fluid/unique_name.py).

Provides ``generate(key)`` producing ``key_0, key_1, ...`` within the current
generator, plus ``guard`` to scope a fresh namespace (used by tests and by
Program construction so two programs built in separate guards get identical
variable names).
"""
from __future__ import annotations

import contextlib


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids: dict[str, int] = {}

    def __call__(self, key: str) -> str:
        i = self.ids.get(key, 0)
        self.ids[key] = i + 1
        return self.prefix + "_".join([key, str(i)])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


def switch(new_generator=None) -> UniqueNameGenerator:
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
