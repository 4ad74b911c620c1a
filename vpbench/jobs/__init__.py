"""Jobs: what a cell runs, one file per job.

A cell's traffic file may name its job (``"job": "<name>"``; without the
key the job is ``"serve"``), and ``vpbench/run.py`` loads
``vpbench/jobs/<name>.py`` from the run's checkout by path. The harness
keeps what every job shares: the set-up clock, the closed loop and its
stop rule, the window's rate and tail over all steps, the profiled
stretch, the spans pass, the peak memory, the verdict by the cell's
limits and the result line. The module supplies the rest:

``build(config, traffic, seed, dev, root, mark)`` builds the program
and its inputs from the configuration, the traffic and ``seed`` on
``dev`` (``root``: the checkout), calling ``mark(name)`` at the end of
each set-up phase it wants logged, and returns an object with:

* ``items``: the items one step completes (images, training images);
* ``judged``: the sorted window positions whose steps are judged;
* ``warm_up()``: the warm-up sends, every shape the window uses;
* ``step(i)``: the ``i``-th window step (``i`` from 0), ending on the
  host read that stops its clock; returns what the step produced. The
  traced stretch calls it again for ``i`` below the stretch's length;
* ``keep(i, out)``: what a judged step ``i`` keeps of its output;
* ``traced(kept, n)``: after the window of a ``--trace 1`` run, the job's
  extras for the metric readers, over the stretch's ``n`` steps; the
  ``Trace`` answers to their attributes (``vpbench/metrics/``);
* ``free()``: drop the program's state before the reference runs;
* ``judge(kept)``: the plain reference's comparison of the kept outputs
  -> ``{number: value}``, each number with a limit in the cell's
  ``vpbench/limits/<workload>.json``.
"""
