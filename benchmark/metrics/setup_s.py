"""``setup_s``: seconds from the process's start to the first timed step
(building or loading the kernels, the scene, the weights, the trainer and
its first steps, which warm the step's shapes), host clock."""


def read(w):
    return w.setup_s
