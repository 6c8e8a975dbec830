"""Host time of generate_ent_embeddings per round, s (benchmark span, ended by
the round's synchronisation)."""

from portbench.layers import span_mean


def read(run):
    return span_mean(run, 'ent_sweep')
