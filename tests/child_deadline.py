"""A limit on test blocks that wait for child processes
(tests/test_torch_run.py, tests/test_torch_accept.py)."""
import contextlib
import signal
import threading


@contextlib.contextmanager
def deadline(seconds: int):
    """Fail, rather than wait without a limit, when the block (a run of
    child processes) outlasts `seconds`: SIGALRM raises in the main thread,
    and subprocess.run kills its child on the way out. Off outside the
    main thread, where no alarm can be set."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"child processes still running after {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
