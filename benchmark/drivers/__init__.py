"""Traffic drivers, one module per kind of traffic, found by the name a
traffic file gives under ``"driver"``. A driver defines any of the hooks the
harness runs a cell with, and the harness's own serve for the rest:

* ``make_ring(mix, agents, config, seed, device)``: the inputs
  (``harness/inputs.py``: the image and match rings);
* ``Fleet(config, mix, seed, device, spans, make_ring)``: the system under
  test, one fleet frame per ``frame(k, record)`` (``harness/fleet.py``);
* ``warm_up(fleet, clock, n_min, n_max, record0)`` and
  ``window(fleet, clock, first, seconds, sample_at)``: set-up's frames and the
  measured window (``harness/window.py``: a closed loop, two frames in
  flight);
* ``segment(fleet, clock, first, n_frames, kernels)``: the traced segment of
  a ``--trace 1`` run (``harness/trace.py``);
* ``Judge(fleet, reference, ref_package, program_package, device, control)``
  and ``Reference(config, agents)``: what the window produced against the
  plain reference (``harness/check.py``, ``reference/steps.py``).

A traffic file that names no driver runs on the harness's hooks alone."""
