"""One module per renderer a configuration names (`renderer`): a `User`
that drives the program through the entry points its users call, frame by
frame in a closed loop, and `reference`, the reference's evaluation of what
a window recorded."""
