"""Work over several devices and processes (the JAX package's parallel/):
device meshes (:mod:`.mesh`), the DM-sharded dedispersion and search
(:mod:`.sharded_dedisperse`, :mod:`.sharded_search`), the beam-sharded
coincidence (:mod:`.coincidence`), the FFT of a series split over devices
(:mod:`.distributed_fft`) and the multi-process drivers
(:mod:`.multihost`)."""
