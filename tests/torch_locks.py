"""The seeded lock-order inversion of the port's lockwatch tests
(``test_torch_lockwatch``), in a module of its own: its locks are born
here, so both packages' harnesses name the same allocation sites."""

import threading

import pytest

WAIT_S = 30.0


def inversion(err_type):
    """Thread 1 takes A then B and exits; the calling thread then holds
    B and asks for A, which must raise ``err_type`` instead of
    blocking.  Returns the raised error."""
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    done = threading.Event()

    def t1():
        with lock_a:
            with lock_b:  # records the edge A -> B
                pass
        done.set()

    worker = threading.Thread(target=t1, name="t1-a-then-b")
    worker.start()
    worker.join(WAIT_S)
    assert done.is_set(), "seed thread did not complete"
    with lock_b:
        with pytest.raises(err_type) as ei:
            lock_a.acquire()  # would close the cycle: refused pre-block
    # The refused acquire never took the lock.
    assert lock_a.acquire(blocking=False)
    lock_a.release()
    return ei.value
