"""Mean host time a served step spends in the model's decode call (its
dispatch): the `serve.decode` layer span's total over the count of
`serve.step`, in the traced part of the window."""
from portbench import layers


def read(run):
    return layers.per("serve.decode", "serve.step")
