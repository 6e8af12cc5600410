"""Listener-based state machines for queries and tasks.

Reference: the single generic FSM that underpins all lifecycle tracking —
``core/trino-main/.../execution/StateMachine.java:43`` — and its two main
instantiations ``QueryState.java:21`` (QUEUED→…→FINISHED/FAILED) and
``TaskState.java:21``.
"""
from __future__ import annotations

import threading
from typing import Callable, Generic, List, Optional, Set, TypeVar

S = TypeVar("S")


class StateMachine(Generic[S]):
    """Thread-safe state holder with terminal-state latching and listeners.

    Listeners fire outside the lock (the reference dispatches on an executor;
    here callers are short non-blocking callbacks).
    """

    def __init__(self, initial: S, terminal: Set[S]):
        self._state = initial
        self._terminal = frozenset(terminal)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._listeners: List[Callable[[S], None]] = []

    def get(self) -> S:
        with self._lock:
            return self._state

    def is_terminal(self) -> bool:
        with self._lock:
            return self._state in self._terminal

    def set(self, new_state: S) -> bool:
        """Transition unconditionally unless already terminal. Returns True
        if the state changed."""
        with self._lock:
            if self._state in self._terminal or self._state == new_state:
                return False
            self._state = new_state
            listeners = list(self._listeners)
            self._cond.notify_all()
        for fn in listeners:
            fn(new_state)
        return True

    def compare_and_set(self, expect: S, new_state: S) -> bool:
        with self._lock:
            if self._state != expect or self._state in self._terminal:
                return False
            self._state = new_state
            listeners = list(self._listeners)
            self._cond.notify_all()
        for fn in listeners:
            fn(new_state)
        return True

    def add_listener(self, fn: Callable[[S], None]) -> None:
        with self._lock:
            self._listeners.append(fn)
            current = self._state
        fn(current)

    def wait_for_terminal(self, timeout: Optional[float] = None) -> S:
        with self._cond:
            # lint: allow(blocking-under-lock) Condition.wait_for RELEASES the lock; set()/compare_and_set never block
            self._cond.wait_for(lambda: self._state in self._terminal, timeout)
            return self._state


# Query lifecycle (reference: QueryState.java:21).
QUERY_STATES = [
    "QUEUED", "PLANNING", "STARTING", "RUNNING", "FINISHING",
    "FINISHED", "FAILED", "CANCELED",
]
QUERY_TERMINAL = {"FINISHED", "FAILED", "CANCELED"}

# Task lifecycle (reference: TaskState.java:21).
TASK_STATES = ["PLANNED", "RUNNING", "FLUSHING", "FINISHED", "FAILED", "CANCELED"]
TASK_TERMINAL = {"FINISHED", "FAILED", "CANCELED"}


def query_state_machine() -> StateMachine[str]:
    return StateMachine("QUEUED", QUERY_TERMINAL)


def task_state_machine() -> StateMachine[str]:
    return StateMachine("PLANNED", TASK_TERMINAL)
