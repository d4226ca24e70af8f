"""A fresh device-memory manager and engine ledger for each test, in both
packages (each keeps one per process): a module that imports
``fresh_ledger`` gets it for every test."""

import pytest

from audio_rag_tpu.engine import engine as jax_engine
from audio_rag_tpu.resources import manager as jax_manager
from audio_rag_tpu_torch.engine import engine as port_engine
from audio_rag_tpu_torch.resources import manager as port_manager


def reset_ledgers() -> None:
    for mod in (port_manager, jax_manager):
        mod.set_resource_manager(None)
    for mod in (port_engine, jax_engine):
        mod.set_engine(None)


@pytest.fixture(autouse=True)
def fresh_ledger():
    reset_ledgers()
    yield
    reset_ledgers()
