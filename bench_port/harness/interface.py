"""What a kind of traffic gives the harness. A mix's file
(``traffic/<mix>.json``) names its `kind`; the kind is the module
``kinds/<kind>.py``, found by that name, with these functions:

    setup(cell, seed, device, overrides=()) -> program
        the program under test with its weights and inputs, from the seed
    warm_up(program)
        every shape the window will use, and no other
    window(program, seconds, rng, profiler=None) -> Window
        the timed traffic; with a profiler, a steady part of it traced, each
        request (or step) inside a ``trace.REQUEST`` range
    free(program)
        drop the program's state on the card, once the peak has been read
    check(cell, program, window, rng, device) -> Checked
        the numbers held to the configuration's `limits`, from the answers
        the window produced against the plain reference
    report(cell, program, window, checked, trace) -> Report
        the end-to-end values, and the facts the per-layer readers read
    reference_control(cell, seed, device, dtype) -> {number: value}
        (optional) the reference in the program's place at `dtype`, for a
        configuration whose `control` is of kind "reference"

A new kind is a new module and a mix file that names it; nothing that is
there changes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Request:
    key: int  # which input: a batch of the pool, a pool frame, a step
    send: float  # host clock when the input was handed to the program
    done: float  # host clock when its answer was on the host
    images: int
    due: Optional[float] = None  # open loop: when it fell due
    traced: bool = False


@dataclass
class Window:
    requests: List[Request] = field(default_factory=list)
    outputs: List[Any] = field(default_factory=list)  # one answer per request
    start: float = 0.0
    end: float = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Checked:
    numbers: Dict[str, float]  # each held to the configuration's limit of the same name
    reference: Any = None  # whatever the report needs of the reference (its record of the work)


@dataclass
class Report:
    end_to_end: Dict[str, float]  # values by metric name; the harness adds setup_s
    attempted: int
    failed: int = 0
    facts: Dict[str, Any] = field(default_factory=dict)  # what the readers read besides `trace`
    info: Dict[str, Any] = field(default_factory=dict)  # printed on the line before the result
