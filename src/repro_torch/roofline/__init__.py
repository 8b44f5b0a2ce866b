"""Cost accounting over torch: what a rank runs in a step, and the roofline.

Port of ``repro.roofline``, which parses XLA's HLO against a TPU model:
:mod:`.counter` counts the step itself as it runs (on ``meta`` tensors in
the dry-run, on the card to check the count), :mod:`.analysis` costs the
collectives and gives the three roofline terms on an H100 model, and
:mod:`.report` prints the dry-run's table.
"""
