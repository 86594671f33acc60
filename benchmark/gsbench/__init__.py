"""The port's benchmark: the harness (``harness``), the yardstick's counts and
peaks (``counts``), trace reading (``trace``, ``readers``), seeded weights
(``weights``) and what it takes from the program (``program``)."""
