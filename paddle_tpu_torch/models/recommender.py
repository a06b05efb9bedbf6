"""MovieLens personalized recommender (reference:
python/paddle/fluid/tests/book/test_recommender_system.py: an embedding
a feature for the user tower and the movie tower, cosine similarity
scaled to the 1-5 rating range, squared-error regression).

The port's copy of the JAX package's ``paddle_tpu/models/recommender.py``:
the same Program.  The ragged features (a movie's categories and its
title's words) are padded with lengths, sum-pooled and
sequence-conv-pooled.  The port has no ``dataset`` package, so the
vocabulary sizes are ``get_model`` arguments; their defaults are the
JAX package's synthetic MovieLens (``paddle_tpu/dataset/movielens.py``,
used when the real archive is absent), copied below.  MovieLens-1M's
own are 6,040 users, 3,952 movies, 21 jobs and 18 genres.  Two ragged
feeds keep the Program off the CUDA graph: each step runs op by op.
"""
from __future__ import annotations

from .. import framework, layers, nets, optimizer as optim
from ..param_attr import ParamAttr

EMB = 32
TOWER = 200

# the JAX package's synthetic MovieLens, when it has no real archive
NUM_USERS = 200
NUM_MOVIES = 300
NUM_JOBS = 21
NUM_CATEGORIES = 18  # movielens.CATEGORIES, the 18 MovieLens genres
TITLE_VOCAB = 512


def _user_tower(uid, gender, age, job, max_user_id, max_job_id):
    feats = []
    for var, vocab, width, name in (
        (uid, max_user_id + 1, EMB, "user_table"),
        (gender, 2, 16, "gender_table"),
        (age, 8, 16, "age_table"),
        (job, max_job_id + 1, 16, "job_table"),
    ):
        emb = layers.embedding(
            input=var, size=[vocab, width], dtype="float32",
            param_attr=ParamAttr(name=name),
        )
        feats.append(layers.fc(input=emb, size=width))
    return layers.fc(input=layers.concat(feats, axis=1), size=TOWER, act="tanh")


def _movie_tower(mid, categories, title, max_movie_id, n_categories,
                 title_dict_size):
    mov_emb = layers.embedding(
        input=mid, size=[max_movie_id + 1, EMB], dtype="float32",
        param_attr=ParamAttr(name="movie_table"),
    )
    mov_fc = layers.fc(input=mov_emb, size=EMB)

    cat_emb = layers.embedding(
        input=categories, size=[n_categories, EMB], dtype="float32",
    )
    cat_pool = layers.sequence_pool(input=cat_emb, pool_type="sum")

    title_emb = layers.embedding(
        input=title, size=[title_dict_size, EMB], dtype="float32",
    )
    title_conv = nets.sequence_conv_pool(
        input=title_emb, num_filters=EMB, filter_size=3, act="tanh",
        pool_type="sum",
    )
    combined = layers.concat([mov_fc, cat_pool, title_conv], axis=1)
    return layers.fc(input=combined, size=TOWER, act="tanh")


def get_model(lr=5e-3, max_user_id=NUM_USERS, max_movie_id=NUM_MOVIES,
              max_job_id=NUM_JOBS - 1, n_categories=NUM_CATEGORIES,
              title_dict_size=TITLE_VOCAB):
    """Build the two-tower model; returns a dict with keys
    ``main``/``startup``/``feeds``/``infer``/``loss``.  The id tables
    hold ``max_*_id + 1`` rows (ids count from 1, as MovieLens's do)."""
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        uid = layers.data(name="user_id", shape=[1], dtype="int64")
        gender = layers.data(name="gender_id", shape=[1], dtype="int64")
        age = layers.data(name="age_id", shape=[1], dtype="int64")
        job = layers.data(name="job_id", shape=[1], dtype="int64")
        mid = layers.data(name="movie_id", shape=[1], dtype="int64")
        cats = layers.data(name="category_id", shape=[1], dtype="int64", lod_level=1)
        title = layers.data(name="movie_title", shape=[1], dtype="int64", lod_level=1)
        score = layers.data(name="score", shape=[1], dtype="float32")

        usr = _user_tower(uid, gender, age, job, max_user_id, max_job_id)
        mov = _movie_tower(mid, cats, title, max_movie_id, n_categories,
                           title_dict_size)
        sim = layers.cos_sim(X=usr, Y=mov)
        scale_infer = layers.scale(x=sim, scale=5.0)
        avg_cost = layers.reduce_mean(
            layers.square_error_cost(input=scale_infer, label=score))
        optim.SGD(learning_rate=lr).minimize(avg_cost)

    feeds = ["user_id", "gender_id", "age_id", "job_id", "movie_id",
             "category_id", "movie_title", "score"]
    return {"main": main, "startup": startup, "feeds": feeds,
            "infer": scale_infer, "loss": avg_cost}
