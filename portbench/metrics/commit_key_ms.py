"""Mean host time a commit spends getting its commit program
(`Protector.commit_program`: the key built from the page set, the lookup,
and the build on a miss): the `txn.commit_program` layer span's total
over the count of `pool.commit`, in the traced part of the window."""
from portbench import layers


def read(run):
    return layers.per("txn.commit_program", "pool.commit")
