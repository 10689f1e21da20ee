"""Probes and diagnostics of the port, the counterparts of the JAX
package's `prof/` scripts that hold TPU kernels: `diag_iters` (the bench's
traversal-efficiency figures, K6 and K7), `probe_prebuilt` (K7 timed) and
`prof_skyround` (K8, one regen round split into its parts). `scenes` builds
the bench courtyard through the production asset path."""
