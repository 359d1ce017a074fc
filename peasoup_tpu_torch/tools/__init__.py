"""The port's tools: :mod:`.parsers` reads the search outputs, :mod:`.perf`
runs the tuning and measurement layer, :mod:`.scope_trace` attributes
device time to the drivers' scopes, :mod:`.validate_manifest` checks
telemetry manifests against their schema and :mod:`.watch` renders a
campaign's status; :mod:`.chaos` is the chaos soak, :mod:`.plotting` the
DM-time bowtie and the candidate sheet, :mod:`.report` renders, diffs and
merges manifests, :mod:`.as_text` prints a candidate table,
:mod:`.recall` matches candidates against a golden run,
:mod:`.divergence` holds the search's stages against an f64 oracle and
:mod:`.tie_mc` replays the distil chain under S/N perturbations."""
