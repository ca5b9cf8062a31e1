"""The beam configs of ``streaming.StreamingTranscriber`` against the JAX
package's on the CPU (the models and the helpers are in
``tests/test_torch_streaming.py``): beam commits forced onto the frames by
``ctc_viterbi_align`` on the tiny ``bigru-ctc``, and the tiny ``hybrid``
model's prefix beam with char-LM fusion for the live tail and the joint
beam over the segment at ``finish``. After every ``feed`` the transcript,
the committed text, ``_ctx``, the buffer's length and ``cut_events`` are
equal (exact), the buffered ROIs within 1e-4."""

import numpy as np
import pytest
import torch

from lipreading_tpu import infer as jinf
from lipreading_tpu_torch.infer import decode_ids
from tests.test_torch_helpers import file_hang_guard  # noqa: F401
from tests.test_torch_streaming import (  # noqa: F401
    _eager_decode,
    _same_buffer,
    _state,
    _streams,
    _video,
    check_config,
    models,
    prep,
    two_torch_threads,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard")

# (model, video, chunk sizes (None: 16s), transcriber kwargs, counts that
# must be > 0)
CONFIGS = {
    "beam4_viterbi": ("bigru", "clip0", None,
                      dict(window=32, decode_every=8, beam=4),
                      ("commits", "viterbi", "tail_beam")),
    "hybrid_beam_lm": ("hybrid", "clip0", None,
                       dict(window=32, decode_every=8, beam=3, lm_weight=0.4),
                       ("viterbi", "tail_beam", "segment")),
}
# the tracked gap stream through the hybrid's beams: its last segment is
# where the JAX package's jitted joint beam parts from the same beam op by op
GAP_HYBRID = dict(window=32, decode_every=8, tracked=True, beam=3,
                  lm_weight=0.4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_beam_stream_matches_jax_after_every_feed(models, prep, name):
    check_config(models, prep, CONFIGS[name])


def test_tracked_hybrid_stream_and_its_near_tie(models, prep):
    """The tracked gap stream (a cutaway between two clips) through the
    tiny hybrid's prefix beam with the LM, the gap flush and the joint
    beam over each segment: every feed equal to JAX's. Its last segment
    is the one where the JAX package's jitted joint beam and the same
    beam op by op part (XLA's fused program rounds apart from its ops one
    by one; the tiny model's scores are near flat): the port's decode
    equals the op-by-op one, which the JAX transcriber runs here."""
    js, ps = _streams(models, prep, "hybrid", **GAP_HYBRID)
    frames = _video("gap")
    for k, lo in enumerate(range(0, len(frames), 16)):
        assert ps.feed(frames[lo:lo + 16]) == js.feed(frames[lo:lo + 16])
        assert _state(ps) == _state(js), k
        _same_buffer(ps, js, k)
    assert ps.counts["flushes"] > 0 and ps.counts["segment"] > 0
    seg = np.stack(js._buf[js._ctx:])
    T = seg.shape[0]
    seg = np.pad(seg, ((0, 32 - T), (0, 0), (0, 0)))[None]
    m = models["hybrid"]
    lengths = np.asarray([T], np.int32)
    jitted = jinf._decode_jit(m["jcfg"], 3, 0.4)(m["params"], seg, lengths)
    eager = _eager_decode(m["jcfg"], 3, 0.4)(m["params"], seg, lengths)
    ids, n = decode_ids(m["model"], m["cfg"], torch.from_numpy(seg),
                        torch.from_numpy(lengths), 3, 0.4)
    text = [ps.vocab.decode(np.asarray(i)[0, :int(np.asarray(k)[0])])
            for i, k in (jitted, eager, (ids, n))]
    assert text[2] == text[1] != text[0], text
    assert ps.finish() == js.finish()
    assert ps.counts["viterbi"] > 0
