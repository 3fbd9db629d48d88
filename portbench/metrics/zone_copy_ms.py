"""Mean host time a commit spends sharding the new state into the zone's
leaves (`Pool.to_zone` in the commit, the zone copies' enqueue): the
`pool.to_zone` layer span's total over the count of `pool.commit`, in the
traced part of the window."""
from portbench import layers


def read(run):
    return layers.per("pool.to_zone", "pool.commit")
