"""Embedding training: the APS (Alink Parameter Server) analog (port of
``alink_tpu.embedding``).

The reference trains huge embeddings through a pull/push mini-batch
parameter server (operator/common/aps/ApsEnv.java; used by
huge/impl/Word2VecImpl.java and the DeepWalk/Node2Vec ops). Here the
embedding tables live on the card; per step one launch of the
``sgns_block_grads`` kernel pulls the rows a block of pairs touches and
computes the block's gradients, and the updates are pushed back
(``parallel/aps.py``).
"""

from .engine import huge_engine, train_embedding
from .skipgram import (
    SkipGramConfig,
    build_vocab,
    make_pairs,
    train_skipgram,
    train_skipgram_sharded,
)
from .walks import node2vec_walks, random_walks

__all__ = [
    "SkipGramConfig",
    "huge_engine",
    "train_embedding",
    "train_skipgram",
    "train_skipgram_sharded",
    "build_vocab",
    "make_pairs",
    "random_walks",
    "node2vec_walks",
]
