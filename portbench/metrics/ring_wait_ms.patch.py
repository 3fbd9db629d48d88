"""Mean host time a commit waits on the commit ring for an earlier
commit's verdict (a full ring's forced resolve of its oldest ticket, and
a drain): the `ring.wait` layer span's total over the count of
`pool.commit`, in the traced part of the window."""
from portbench import layers


def read(run):
    return layers.per("ring.wait", "pool.commit")
