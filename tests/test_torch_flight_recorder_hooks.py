"""The flight recorder's exception hooks beside the JAX package's recorder.

One process can run both recorders (the mixed cross-silo tests run a JAX
server beside port clients), and their installs and uninstalls interleave.
Whatever the order, the port's hooks never chain to one another or to
themselves, an uncaught exception still reaches the interpreter's default
hook, and a later install and uninstall put back exactly what they found.
"""

import sys
import threading

import pytest

from fedml_tpu.core.telemetry import flight_recorder as jfr
from fedml_tpu_torch.core.telemetry import flight_recorder as tfr

# interleavings of one port and one JAX install/uninstall pair. Left out:
# JAX, port, JAX out, port out, where the JAX uninstall finds the port's
# hook on top and drops its own stored previous hook (the JAX module's
# state, which the port cannot reach): its hook then prints nothing
ORDERS = {
    "port_jax_port_jax": ("t+", "j+", "t-", "j-"),
    "port_jax_jax_port": ("t+", "j+", "j-", "t-"),
    "jax_port_port_jax": ("j+", "t+", "t-", "j-"),
}


def _step(op):
    mod = tfr if op[0] == "t" else jfr
    if op[1] == "+":
        mod.install(role=f"{op[0]}_interleave")
    else:
        mod.uninstall()


def _port_hooks_in_chain(hook):
    """The port's hooks reachable from ``hook`` along ``prev`` (stopping at
    the first hook that is not the port's)."""
    seen = []
    while isinstance(hook, tfr._ChainedHook):
        assert all(hook is not h for h in seen), "a port hook chains to itself"
        seen.append(hook)
        hook = hook.prev
    return seen


@pytest.fixture
def default_hooks():
    """Both hooks start at the interpreter's defaults and are put back after
    the test, whatever it left on top."""
    saved = (sys.excepthook, threading.excepthook)
    sys.excepthook, threading.excepthook = sys.__excepthook__, threading.__excepthook__
    yield
    while tfr.active() is not None:
        tfr.uninstall()
    while jfr.active() is not None:
        jfr.uninstall()
    sys.excepthook, threading.excepthook = saved


@pytest.mark.parametrize("order", list(ORDERS))
def test_interleaved_installs_keep_the_default_hook_reachable(order, default_hooks, capsys):
    """Exact: after each order, the hooks on top pass an uncaught exception
    to ``sys.__excepthook__`` (its traceback on stderr, once) and to
    ``threading.__excepthook__``; no port hook's ``prev`` is a port hook."""
    for op in ORDERS[order]:
        _step(op)
    assert tfr.active() is None and jfr.active() is None
    for hook in (sys.excepthook, threading.excepthook):
        chain = _port_hooks_in_chain(hook)
        assert len(chain) <= 1, chain
        for h in chain:
            assert not isinstance(h.prev, tfr._ChainedHook)
    try:
        raise ValueError("interleaved boom")
    except ValueError:
        sys.excepthook(*sys.exc_info())
    err = capsys.readouterr().err
    assert err.count("ValueError: interleaved boom") == 1, err

    t = threading.Thread(target=lambda: (_ for _ in ()).throw(KeyError("thread boom")))
    t.start()
    t.join()
    err = capsys.readouterr().err
    assert err.count("KeyError: 'thread boom'") == 1, err


def test_port_hook_left_under_jax_s_is_never_stored_as_previous(default_hooks):
    """Port install, JAX install, port uninstall, JAX uninstall leaves the
    port's stale hook on top; a later port install chains past it (to the
    default) and its uninstall puts the stale hook back, which is what
    ``test_flight_recorder_excepthooks_restore`` asserts after the mixed
    cross-silo tests."""
    for op in ORDERS["port_jax_port_jax"]:
        _step(op)
    stale = sys.excepthook
    assert isinstance(stale, tfr._ChainedHook) and stale.prev is sys.__excepthook__
    rec = tfr.install(role="t")
    try:
        live = sys.excepthook
        assert live is not stale and tfr.active() is rec
        assert live.prev is sys.__excepthook__  # the stale hook is skipped
        assert live.prev is not live
    finally:
        tfr.uninstall()
    assert sys.excepthook is stale and tfr.active() is None


def test_excepthooks_restore_passes_after_a_mixed_interleave(default_hooks):
    """The telemetry front's own test, run after the interleave the mixed
    cross-silo federations leave behind."""
    from tests.test_torch_telemetry_front import test_flight_recorder_excepthooks_restore

    for op in ORDERS["port_jax_port_jax"]:
        _step(op)
    test_flight_recorder_excepthooks_restore()


def test_live_hook_dumps_once_then_passes_on(default_hooks, tmp_path, capsys):
    """The live hook records the exception and writes one dump, then the
    default hook prints the traceback once."""
    rec = tfr.install(role="t", recorder=tfr.FlightRecorder(dump_dir=str(tmp_path)))
    try:
        try:
            raise RuntimeError("live boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        assert rec.dump_count == 1
    finally:
        tfr.uninstall()
    assert capsys.readouterr().err.count("RuntimeError: live boom") == 1
    assert sys.excepthook is sys.__excepthook__
