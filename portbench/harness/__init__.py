"""The benchmark's general code: the cells of ``BENCHMARK.json`` resolved
by name (``cells``), the traffic generator (``traffic``), the weights
made from the seed (``weights``), the work and peak arithmetic
(``work``), the profiler's reading (``trace``) and the result line
(``result``). Nothing here imports the program under test."""
