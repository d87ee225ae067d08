"""MovieLens-1M readers (reference: python/paddle/dataset/movielens.py).
Items: [user_id, gender, age, job, movie_id, categories, title, score]."""
from __future__ import annotations

import numpy as np

_SYNTH_N = 512


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index, [c for c in self.categories],
                [t for t in self.title.split()]]


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == 'M'
        self.age = age
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age,
                self.job_id]


def max_movie_id():
    return 3952


def max_user_id():
    return 6040


def max_job_id():
    return 20


def movie_categories():
    return {c: i for i, c in enumerate(
        ["Action", "Adventure", "Animation", "Children's", "Comedy",
         "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir",
         "Horror", "Musical", "Mystery", "Romance", "Sci-Fi",
         "Thriller", "War", "Western"])}


def user_info():
    rs = np.random.RandomState(7)
    return {i: UserInfo(i, 'M' if rs.rand() < 0.5 else 'F',
                        int(rs.randint(1, 57)), int(rs.randint(21)))
            for i in range(1, 101)}


def movie_info():
    rs = np.random.RandomState(8)
    cats = list(movie_categories())
    return {i: MovieInfo(i, [cats[rs.randint(len(cats))]], f"title {i}")
            for i in range(1, 101)}


def _synth_reader(seed):
    users, movies = user_info(), movie_info()

    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(_SYNTH_N):
            u = users[int(rs.randint(1, 101))]
            m = movies[int(rs.randint(1, 101))]
            score = float(rs.randint(1, 6))
            yield u.value() + m.value() + [[score]]

    return reader


def train():
    return _synth_reader(0)


def test():
    return _synth_reader(1)


def get_movie_title_dict():
    return {f"title": 0}


def age_table():
    return [1, 18, 25, 35, 45, 50, 56]


def fetch():
    from .common import download
    download("https://dataset.bj.bcebos.com/movielens%2Fml-1m.zip",
             "movielens", None)
