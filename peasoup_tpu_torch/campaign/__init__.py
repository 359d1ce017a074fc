"""The campaign candidate database (:mod:`.db`) and the shape buckets
(:mod:`.buckets`); the rest of the JAX package's campaign layer (queue,
runner, rollup, tenants, autoscale) is ROADMAP item A.10."""
