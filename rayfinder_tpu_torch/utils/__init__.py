"""Small helpers: math utilities and PNG I/O (the port's copies of
`rayfinder_tpu.utils`)."""
