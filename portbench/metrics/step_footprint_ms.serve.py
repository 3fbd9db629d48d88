"""Mean host time a served step spends working out its commit's footprint
on the host (the page or word list of the step's time slot): the
`serve.footprint` layer span's total over the count of `serve.step`, in
the traced part of the window."""
from portbench import layers


def read(run):
    return layers.per("serve.footprint", "serve.step")
