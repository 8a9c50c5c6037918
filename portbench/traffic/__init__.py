"""Traffic: one data file a mix (``<name>.json``), read by the generator
its ``kind`` names (``<kind>.py``).  A generator gives `warm_sizes` (the
call sizes that build every wave shape the mix can make) and `run` (the
measured window)."""
