"""One module a kind of work; a traffic mix names its driver. Each has
``run(r)``, which sets the program up from ``r.cell``, runs the measured
window, frees the program's state, compares with the reference and fills
``r`` (see ``portbench.run.Run``)."""
