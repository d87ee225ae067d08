"""BERT encoder and heads: the port of ``paddle_tpu/models/bert.py``
(BASELINE.json config 2: BERT-base MLM under AMP O2), built on the port's
``nn.TransformerEncoder`` (the reference's nn/layer/transformer.py:786
stack).

Attention goes through ``F.scaled_dot_product_attention``: on the card,
without a mask and without dropout (eval), that is the library tier's
Hopper forward kernel; with a mask or in training (dropout 0.1) it is the
plain path, in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=256, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128,
                          max_seq_len=64)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_seq_len,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        # BERT initializer_range=0.02 (the tied LM head needs small-std
        # embeddings or the initial logits blow up to std sqrt(h))
        for emb in (self.word_embeddings, self.position_embeddings,
                    self.token_type_embeddings):
            emb.weight._assign_array(emb.weight._data.detach() * 0.02)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, epsilon=1e-12)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = paddle.arange(s, dtype="int64").unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = paddle.zeros_like(input_ids)
        x = self.word_embeddings(input_ids) \
            + self.position_embeddings(pos) \
            + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.dropout, activation="gelu")
        self.encoder = nn.TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            # [B, S] 1/0 -> additive [B, 1, 1, S]
            mask = (1.0 - attention_mask.astype("float32")) * -1e4
            mask = mask.unsqueeze(1).unsqueeze(1)
        seq = self.encoder(x, mask)
        pooled = paddle.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForMaskedLM(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = BertModel(cfg)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, epsilon=1e-12)
        self.decoder_bias = self.create_parameter(
            (cfg.vocab_size,), None, is_bias=True)
        self.loss_fn = nn.CrossEntropyLoss(ignore_index=-100)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.layer_norm(F.gelu(self.transform(seq)))
        # the decoder is tied to the word embeddings
        logits = paddle.matmul(
            h, self.bert.embeddings.word_embeddings.weight,
            transpose_y=True) + self.decoder_bias
        if labels is None:
            return logits
        return self.loss_fn(logits.reshape([-1, logits.shape[-1]]),
                            labels.reshape([-1]))


class BertForSequenceClassification(nn.Layer):
    def __init__(self, cfg: BertConfig, num_classes=2):
        super().__init__()
        self.bert = BertModel(cfg)
        self.dropout = nn.Dropout(cfg.dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)
        self.loss_fn = nn.CrossEntropyLoss()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return self.loss_fn(logits, labels)
