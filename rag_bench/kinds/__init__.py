"""What a cell runs, one module a kind: ``kinds/<kind>.py``, named by the
``"kind"`` key of the cell's configuration file (``hybrid`` where it has
none). ``run.py`` is the same for every kind; the kind module holds all
that is the cell's own. It provides:

``CONTROL``
    One line naming the control of its correctness check (the reference
    one precision step lower, put in the program's place), or None where
    the kind has none: then no control is run for it.

``Run(cell, seed, device)``
    The inputs, made from the seed on ``device`` (a corpus, the pool of
    batches the loop serves, the seed of a model's weights); counted in
    ``setup_s``. Its methods, in the order the harness calls them:

    ``build(mark)``
        The program's state over the inputs, warmed over every batch of
        the pool, so that nothing builds or compiles in the window;
        counted in ``setup_s``. ``mark(name)`` records a phase's end in
        the info line's ``setup_phases_end_s``.
    ``drive(loop, seconds) -> rag_bench.window.Window``
        The window: the traffic's ``loop`` module driven with what the
        kind passes it, filling the fields ``window.py`` states (for a
        model kind, ``queries`` are the questions answered).
    ``free()``
        Releases the program's state, after ``memory_peak_bytes`` is read
        and before the check; the harness calls it even when a step
        before it raised.
    ``check(window, control) -> (correct, checks, control_readings)``
        The window's outputs against the kind's own plain reference:
        ``checks`` maps each number compared to ``{"value", "limit"}``,
        the limits being the kind's own keys of ``limits/<cell>.json``;
        with ``control`` true, also the control's numbers by the same
        names (else None).
    ``values() -> dict``
        What the kind's metric readers read beside the window, the trace
        and the peaks, as attributes of ``run.Context``.
    ``info``
        A dict of the kind's own keys for the info line.
"""
