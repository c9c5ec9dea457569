"""The traffic repeats exactly for a seed and differs between seeds."""

import itertools
import os

import numpy as np

from portbench import traffic
from portbench.harness import HERE, load_json

QUESTIONS = load_json(HERE, "traffic", "gallery-prepared.json")["questions"]
UPLOADS = dict(load_json(HERE, "traffic", "upload-poisson.json")["uploads"],
               long_sides=[64, 96])
GALLERY = dict(load_json(HERE, "traffic", "gallery-prepared.json")["gallery"],
               n_images=12, n_boxes=5)


def _questions(seed, gallery, n=200):
    return [(q.task_id, q.text, tuple(q.images)) for q in itertools.islice(
        traffic.question_stream(QUESTIONS, seed, gallery), n)]


def test_questions_repeat_for_a_seed_and_differ_between_seeds(tmp_path):
    g = traffic.write_gallery(GALLERY, 5, str(tmp_path / "g"), 8)
    assert _questions(5, g) == _questions(5, g)
    assert _questions(5, g) != _questions(6, g)


def test_question_mix_holds_the_eight_tasks_and_their_image_counts(tmp_path):
    g = traffic.write_gallery(GALLERY, 5, str(tmp_path / "g"), 8)
    qs = _questions(9, g, 4000)
    tasks = {t for t, _, _ in qs}
    assert tasks == set(traffic.TASK_IDS.values())
    for t, text, images in qs:
        assert len(images) == (2 if t == 12 else len(images) if t == 7
                               else 1)
        if t == 7:
            assert 2 <= len(images) <= 10
        words = text.replace("?", " ").split()
        assert len(words) >= 3
    rows = np.mean([len(i) for _, _, i in qs])
    assert 1.6 < rows < 1.9  # ~1.75 rows a question


def test_gallery_files_repeat_for_a_seed(tmp_path):
    a = traffic.write_gallery(GALLERY, 3, str(tmp_path / "a"), 8)
    b = traffic.write_gallery(GALLERY, 3, str(tmp_path / "b"), 8)
    c = traffic.write_gallery(GALLERY, 4, str(tmp_path / "c"), 8)
    fa = traffic.read_gallery_file(a.paths[0])
    fb = traffic.read_gallery_file(b.paths[0])
    fc = traffic.read_gallery_file(c.paths[0])
    np.testing.assert_array_equal(fa["features"], fb["features"])
    assert not np.array_equal(fa["features"], fc["features"])
    assert [os.path.basename(p) for p in a.paths] == [
        os.path.basename(p) for p in b.paths]


def test_zipf_draws_favour_the_head_of_the_gallery(tmp_path):
    g = traffic.write_gallery(dict(GALLERY, n_images=512, n_boxes=1),
                              1, str(tmp_path / "g"), 2)
    rng = np.random.default_rng(0)
    draws = g.draw(rng, 20000)
    head = set(g.paths[:64])
    share = np.mean([p in head for p in draws])
    assert 0.6 < share < 0.8  # Zipf(1.0) over 512: ~0.70 on the top 64


def test_uploads_repeat_for_a_seed_and_keep_their_sizes(tmp_path):
    from PIL import Image

    a = traffic.write_uploads(UPLOADS, 1, str(tmp_path / "a"))
    b = traffic.write_uploads(UPLOADS, 1, str(tmp_path / "b"))
    c = traffic.write_uploads(UPLOADS, 2, str(tmp_path / "c"))
    assert [open(p, "rb").read() for p in a] == [open(p, "rb").read()
                                                 for p in b]
    assert [open(p, "rb").read() for p in a] != [open(p, "rb").read()
                                                 for p in c]
    sizes = lambda ps: [Image.open(p).size for p in ps]  # noqa: E731
    # in the order of upload_sizes for every seed, so that a stream taking
    # them round by index serves every seed the same sizes
    assert sizes(a) == sizes(c) == traffic.upload_sizes(UPLOADS)


def test_arrivals_repeat_for_a_seed_and_differ_between_seeds():
    a = traffic.arrivals(4.5, 45.0, 1, 2.0, 14)
    b = traffic.arrivals(4.5, 45.0, 1, 2.0, 14)
    c = traffic.arrivals(4.5, 45.0, 2 ** 31 + 7, 2.0, 14)
    d = traffic.arrivals(4.5, 45.0, 1, 2.0, 15)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)
    assert len(a) == len(c) == round(4.5 * 45)
    assert a[0] == 0.0 and a[-1] < 45.0 and c[-1] < 45.0
    assert np.all(np.diff(a) > 0)
    # the same gaps, in another order, with an exponential law's spread
    gaps = lambda x: np.sort(np.diff(np.append(x, 45.0)))  # noqa: E731
    np.testing.assert_allclose(gaps(a), gaps(c), rtol=1e-9)
    g = gaps(a)
    assert 0.85 < g.std() / g.mean() < 1.1


def test_every_block_of_the_window_offers_the_same_load():
    rate, seconds, block = 3.2, 51.0, 2.0
    for seed in (3, 4, 2 ** 31 + 99):
        due = traffic.arrivals(rate, seconds, seed, block, 14)
        gaps = np.diff(np.append(due, seconds))
        blocks = round(seconds / block)
        n = len(due)
        sizes = [n // blocks + (b < n % blocks) for b in range(blocks)]
        at = np.cumsum([0] + sizes)
        sums = [gaps[at[b]:at[b + 1]].sum() for b in range(blocks)]
        # each block lasts about its share of the window
        assert max(sums) / min(sums) < 1.25
        counts = np.histogram(due, bins=np.arange(0, seconds + 10, 10))[0]
        assert counts[:5].min() >= 0.8 * rate * 10


def test_a_large_seed_is_taken():
    from portbench.weights import stream_seed

    seed = 2 ** 31 + 12345
    assert 0 <= stream_seed(seed, 1) < 2 ** 63
    assert stream_seed(seed, 1) != stream_seed(seed + 1, 1)
